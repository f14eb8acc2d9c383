"""The general part of the benchmark: loading cells by name, the measured
window, the trace reduction, the arithmetic and the comparison."""
