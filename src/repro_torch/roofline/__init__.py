"""The dry-run's counts and their roofline: the fake world (``dry``), the op
counter (``op_stats``), the kernels' cost formulas (``kernel_cost``), the
roofline terms (``analysis``) and the table of a sweep (``table``)."""
