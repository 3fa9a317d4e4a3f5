"""Published model configurations of the port."""
