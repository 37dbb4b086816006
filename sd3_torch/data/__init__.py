"""Input data of the port."""
