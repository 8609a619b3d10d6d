"""The plain reference that decides ``correct``: plain PyTorch from the
raw inputs, importing nothing of the program."""
