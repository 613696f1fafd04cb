"""The plain reference that decides ``correct``: float32 torch, imports
nothing of the program."""
