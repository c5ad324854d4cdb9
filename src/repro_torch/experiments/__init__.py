"""The paper's experiments on the port: Fig 4.1, Fig 4.2, Table 4.1 and the
quickstart, twins of the reference's ``benchmarks/fig4_1.py``,
``fig4_2.py``, ``table4_1.py`` and ``examples/quickstart.py``.

Every random draw of a reference script (test matrices, each Omega, the
MLP's init, the blend matrices, the power method's start vectors) can be
handed in, as ``compress_tree`` takes ``omega_fn``; with nothing handed in,
each is drawn from an explicit ``torch.Generator`` on the run's device,
seeded as the reference seeds its key.  Entry points run on the card
unless ``device="cpu"`` is given.
"""
