"""The plain reference the benchmark judges the program by.

Plain PyTorch only: it imports nothing of the program, of its JAX original or of the
harness, and takes from a run only the inputs the benchmark made (the grid, the stencil's
coefficients, b, the tolerance) and, to judge them, the program's outputs.  A problem
other than the stencil hands ``cg.solve`` its own operator, plain PyTorch as well
(``problems/<name>.py``'s ``apply``).
"""
