"""Numeric constants and registry defaults.

Functional re-design of the constants registry in the reference implementation
(see /root/reference/SubgraphCountingMatching/constants.py:1-39). The string
feature-field registry (NODEFEAT/EDGEFEAT/...) of the reference exists because
DGL stores features in mutable per-graph dicts; our functional design passes
features explicitly, so only the numeric constants survive.
"""

_INF = 1e30
EPS = 1e-8
PI = 3.141592653589793
# Default negative slope of LeakyReLU used throughout the reference
# (constants.py:LEAKY_RELU_A = 1/5.5).
LEAKY_RELU_A = 1.0 / 5.5

# Default scalar-schedule settings (reference constants.py).
INIT_STEPS = 600
SCHEDULE_STEPS = 10000
NUM_CYCLES = 2
MIN_PERCENT = 1e-3
