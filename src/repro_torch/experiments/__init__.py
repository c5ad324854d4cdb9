"""The paper's experiments and the examples on the port: Fig 4.1, Fig 4.2,
Table 4.1, the quickstart, the two serving examples and the two training
examples, twins of the reference's ``benchmarks/fig4_1.py``, ``fig4_2.py``,
``table4_1.py``, ``examples/quickstart.py``, ``examples/compress_and_serve.py``,
``examples/continuous_serving.py`` (llama-only, as the reference's are),
``examples/train_lowrank_lm.py`` (mamba2-130m) and ``examples/rsi_plus_lora.py``.

Every random draw of a reference script (test matrices, each Omega, the
MLP's init, the blend matrices, the power method's start vectors) can be
handed in, as ``compress_tree`` takes ``omega_fn``; with nothing handed in,
each is drawn from an explicit ``torch.Generator`` on the run's device,
seeded as the reference seeds its key.  Entry points run on the card
unless ``device="cpu"`` is given.
"""
