"""Tools of the port."""
