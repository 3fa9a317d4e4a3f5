"""mfu.hostbound: mfu (``mfu.py``) in the cells
that report epoch_ms.hostbound in place of epoch_ms."""
import driver

read = driver.reader("mfu")
