"""Core substrate of the port: simulated fabric, verbs transport, SHIFT,
trilemma.

The port's own copies of the reference's numpy-only fabric modules:
``fabric`` is the deterministic discrete-event network (hosts, RNICs,
rail switches, failure injection, per-rail telemetry); ``verbs`` the RC
transport engine behind a libibverbs-style API, with its own
module-level registries (``verbs.reset_registries``); ``shift`` the
user-space cross-NIC fault-tolerance library the paper contributes;
``protocols`` and ``trilemma`` the failover-semantics models backing
its impossibility results; ``kvstore`` the out-of-band
management-network store. The fabric stays numpy on the host: it models
the network, not device work.
"""
