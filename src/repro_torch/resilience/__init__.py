"""repro_torch.resilience — deterministic fault injection (``chaos``), a
copy of ``repro.resilience.chaos`` cut to the error and drop faults the
streaming index instruments.  The WAL, snapshots and recovery
come with ROADMAP queue A item 10."""
