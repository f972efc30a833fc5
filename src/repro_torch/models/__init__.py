"""Model stack of the port: attention, dense MLP and the transformer
assembly, with the hand-written kernels on the serving path."""
