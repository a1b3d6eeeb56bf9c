"""Explorative inference modes of the port (deepsee_torch.inference.modes)."""
