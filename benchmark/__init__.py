"""The benchmark of the PyTorch and CUDA port: ``python3 -m benchmark.run``
(see ``benchmark/run.py`` and ``BENCHMARK.json``)."""
