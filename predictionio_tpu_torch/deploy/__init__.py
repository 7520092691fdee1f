"""Model lifecycle records of the port (``registry.py``)."""
