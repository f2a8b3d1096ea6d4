"""Host formats, generators, plain PyTorch versions and the plan registry."""
