"""Execution runtime: device resolution and kernel dispatch."""
