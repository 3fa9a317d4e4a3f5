"""agg_launches.hostbound: agg_launches (``agg_launches.py``) in the cells
that report epoch_ms.hostbound in place of epoch_ms."""
import driver

read = driver.reader("agg_launches")
