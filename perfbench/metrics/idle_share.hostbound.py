"""idle_share.hostbound: idle_share (``idle_share.py``) in the cells
that report epoch_ms.hostbound in place of epoch_ms."""
import driver

read = driver.reader("idle_share")
