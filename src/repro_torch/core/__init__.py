"""Roofline analysis for the port: the card's peaks
(:mod:`~repro_torch.core.hardware`), an analytic per-step cost census
(:mod:`~repro_torch.core.census`) and the roofline report
(:mod:`~repro_torch.core.roofline`)."""
