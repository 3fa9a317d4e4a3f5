"""epoch_ms.hostbound: epoch_ms (``epoch_ms.py``) in the cells whose pace
the host sets, under a name of its own so that it has a bound of its own:
the host's pace spreads more from run to run than the card's."""
import driver

read = driver.reader("epoch_ms")
