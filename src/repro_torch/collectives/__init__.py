"""Collectives of the port. Only the error type exists so far: the fabric
(JCCL over the simulated RDMA verbs) is ported in a later slice."""


class CollectiveError(RuntimeError):
    """A collective could not complete (crash-stop abort or timeout)."""
