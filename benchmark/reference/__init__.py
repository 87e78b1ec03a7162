"""Plain float32 PyTorch references of the measured paths. Nothing here
imports the program."""
