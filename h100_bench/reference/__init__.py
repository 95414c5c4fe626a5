"""The plain reference the check compares the program with: plain PyTorch, no code of the port."""
