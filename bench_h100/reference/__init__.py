"""The plain PyTorch reference the program's outputs are held against. It
imports torch and this benchmark's own modules, nothing of the program."""
