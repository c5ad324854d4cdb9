"""Execution runtime: device resolution, kernel dispatch, fault tolerance and
the multi-device layer (``distributed``: meshes, collectives, the rank launcher)."""
