"""Plain PyTorch forward passes that decide ``correct``, and the
comparison itself.  Nothing here imports the program."""
