"""Training-side code of the port. This slice holds the synthetic cluster
generator; the trainers follow in later slices."""
