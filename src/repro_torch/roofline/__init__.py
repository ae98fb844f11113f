"""The roofline of the port (counterpart of ``repro.roofline``).

``analysis``: the card's :class:`~repro_torch.roofline.analysis.Hardware`,
``model_flops`` and the three-term ``roofline_terms``; ``report``: the
roofline table of a dry-run results file; ``counts``: each hand kernel's
operation count and the recorder its wrapper reports its work to;
``flop_stats``: a FLOP counter that sees the aten ops and the hand
kernels, and ``step_flops`` of an (arch, shape) cell on fake tensors.
"""
