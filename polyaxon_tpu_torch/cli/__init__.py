"""The `polyaxon` command line of the port (`main.py`)."""
