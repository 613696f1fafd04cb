"""Dense transformer in PyTorch (the port of ``repro.models``)."""
