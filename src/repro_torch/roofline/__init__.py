"""Roofline terms of the port's steps.  Counterpart of ``repro/roofline``:
the terms, JAX's HLO collective parser and the analytic models
(``analysis``, ``analytic``), the port's own count of a step's FLOPs,
bytes and peak on the meta device (``count``), and the tables of the
dry-run's records (``report``)."""
from .analysis import (HW, HW_F32, Hardware, collective_bytes, model_flops,
                       roofline_terms, traffic_bytes)
