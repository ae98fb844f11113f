"""Architecture config registry of the port.

Importing this package registers the port's architectures with
``repro_torch.config``.  Only internlm2-1.8b (dense GQA, the serving
slice's model) is registered so far.  ``configs.ndp_sim`` holds the
simulator's machines, workloads and presets.
"""
from repro_torch.configs import internlm2_1_8b  # noqa: F401
