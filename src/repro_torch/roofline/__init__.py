"""The roofline: the card's constants, each kernel's cost, the step-level
report (``analysis.py``), and the op counter that measures a step's
FLOPs, bytes and collective bytes (``op_cost.py``)."""
