"""The plain reference the benchmark judges the port by: plain PyTorch,
importing nothing of the port, run on a sample of the timed groups."""
