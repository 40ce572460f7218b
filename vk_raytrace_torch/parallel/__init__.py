"""Multi-device rendering of the port (``sharding.py``)."""
