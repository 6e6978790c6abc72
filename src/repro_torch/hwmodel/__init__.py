"""Analytic hardware model of the paper's accelerator (port of
``repro.hwmodel``; 28 nm, 64x64 array): structural adder-tree costs
(Table II), PE/accelerator energy and the per-tier cycle pricing (Table
III, Fig 8), area/power breakdown (Fig 7), the MobileNetV2 workload
(§IV).  Every figure is the modeled array's, never a speed of the device
the port runs on."""
from repro_torch.hwmodel import (  # noqa: F401
    adder_tree_cost, breakdown, energy, mobilenet)
