"""Training and serving steps: the optimizers (``optimizer``), the train step
with its chunked cross-entropy (``train_step``) and the greedy serving step
(``serve_step``).  The checkpoint-restart loop is
``runtime/fault_tolerance.py::TrainLoopRunner``, driven by
``launch/train.py``; the GPipe pipeline over the ``pod`` axis is
``pipeline_parallel``."""
