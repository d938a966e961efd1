"""The torch twins of the reference's ``examples/``: each mirrors its
script's flow and printed checks on the port, through its public API.

  PYTHONPATH=src python -m repro_torch.examples.<name> [--device cpu]

``quickstart``, ``train_dlrm_e2e``, ``serve_online_updates``,
``loadtest_ensemble``, ``novel_archs``, ``etc_terabyte_training``,
``lm_pretrain_smoke`` and ``mp_train_smoke`` (one process a device:
``torchrun --nproc-per-node 4 -m repro_torch.examples.mp_train_smoke
--device cpu``). Each runs on ``cuda`` unless ``--device cpu`` and takes
size flags whose smallest settings the tests and ``chip_smoke.py`` use.
"""
