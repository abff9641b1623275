"""repro_torch.obs — the port's observability so far: the span tracer
(``trace``) and the projection-drift monitor (``drift``), copies of
``repro.obs``'s.  Metrics export, quality audits and roofline models
come with ROADMAP queue A item 8."""
