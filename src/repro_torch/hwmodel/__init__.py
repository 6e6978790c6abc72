"""Analytic model of the paper's accelerator (port of ``repro.hwmodel``):
so far the per-tier cycle pricing that ``serve.scheduler.SLOPolicy``
reads (``energy``)."""
