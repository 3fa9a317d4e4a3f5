"""Graph partitioners of the port."""
