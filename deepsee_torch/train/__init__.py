"""GAN training of the port: train state and optimizers (state.py), the
step (steps.py), the trainer (loop.py) and `python -m deepsee_torch.train`."""
