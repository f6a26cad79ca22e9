"""The port's runnable entry points, the counterparts of the reference's
``examples/``: each runs as ``python -m repro_torch.examples.<name>``.

* ``quickstart``: SHIFT masking a NIC failure under NCCL-Simple traffic
  on the simulated fabric (numpy on the host, no device);
* ``serve_decode``: batched serving of any of the 11 archs at smoke
  scale, and ``--tp`` over a 2-rank JCCL world;
* ``train_ddp_shift``: data-parallel training over SHIFT with a NIC
  killed mid-run (the paper's §5.2 experiment), ``--full`` for
  gpt2-124m and ``--baseline`` for the StandardLib crash and restart.

``serve_decode`` and ``train_ddp_shift`` run on ``--device cuda`` by
default and raise without a card; ``--device cpu`` runs them on the CPU.
"""
