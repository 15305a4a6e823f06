"""The plain float32 reference that decides ``correct``: PyTorch tensor
operations only, no module of the program under test and nothing it made.
``precision.py`` holds the control, the same math with float8 operands."""
