"""The benchmark of ``raytrace_tpu_torch``: ``python -m benchmark.run``
(see ``benchmark/README.md``)."""
