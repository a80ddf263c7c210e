"""Tools of the port (port of tools/): the device bisect driver."""
