"""The plain reference that decides ``correct``: plain PyTorch, on the
device the run uses, with TF32 off.  It imports nothing of the program.
``frozen/`` holds a frozen copy of the port's plain training modules and
filter bank; ``serve.py`` and ``train.py`` are the references of the two
drivers."""
