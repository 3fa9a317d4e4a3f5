"""ell_roofline.hostbound: ell_roofline (``ell_roofline.py``) in the cells
that report epoch_ms.hostbound in place of epoch_ms."""
import driver

read = driver.reader("ell_roofline")
