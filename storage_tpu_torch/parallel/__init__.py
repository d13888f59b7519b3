"""Path-parallel valuation over a ``torch.distributed`` process group (the
counterpart of ``storage_tpu.parallel``): ``reduce`` (the cross-rank sums the
engine takes), ``mesh`` (the sharded engine entry points) and
``distributed`` (process groups, host-local panels)."""
