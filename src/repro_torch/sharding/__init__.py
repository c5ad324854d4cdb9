"""Sharding rules over the port's param trees (``sharding/rules.py``)."""
