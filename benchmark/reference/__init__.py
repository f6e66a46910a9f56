"""The plain float32 reference the benchmark judges the port's outputs
against: frozen copies of the port's plain modules (geometry, diffusion
transitions, embeddings, the eager GAEncoder over a plain attention, the
dense-masked EGNN, the losses), kernel routes and process groups taken
out, so that a later change to the program cannot move it. It imports
neither ``jax`` nor either package of this repository."""
