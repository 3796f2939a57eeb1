"""The yardstick of the kernels' rooflines: the published H100 peaks and,
one module per operation (named as the program's entry point), the bytes
and operations a call needs, reckoned from its shapes."""
