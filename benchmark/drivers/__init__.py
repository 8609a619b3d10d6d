"""What a traffic mix drives: each module here is named by a traffic
file's ``driver`` and has a ``Driver(config, traffic, seed, device)``."""
