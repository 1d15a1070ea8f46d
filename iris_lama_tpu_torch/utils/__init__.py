"""Host-side scan utilities, the synthetic world, evaluation, the
map-state converter, the buffer codec and checkpoints."""
