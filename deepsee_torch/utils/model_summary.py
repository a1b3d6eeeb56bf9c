"""Parameter counts, port of deepsee_tpu/utils/model_summary.py (reference:
util/model_summary.py, BaseNetwork.print_network, base_network.py:18-26).
Parameters only: spectral u/v and running statistics are buffers."""

from __future__ import annotations

from typing import Dict, Optional

import torch


def count_params(module: torch.nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())


def summarize(nets: Dict[str, Optional[torch.nn.Module]]) -> str:
    """nets: e.g. {"SR": system.generator, "D": system.discriminator,
    "E": system.encoder}; None entries are skipped."""
    return "\n".join(f"Network [{name}] was created. Total number of parameters: "
                     f"{count_params(net) / 1e6:.1f} million."
                     for name, net in nets.items() if net is not None)
