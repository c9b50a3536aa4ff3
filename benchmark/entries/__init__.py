"""Drivers of the program's public entries, one module per entry kind a
traffic mix names (``"entry"``)."""
