"""The port's copies of the reference's examples, run as
``python -m repro_torch.examples.<name>`` (on the card unless
``--device cpu`` is given)."""
