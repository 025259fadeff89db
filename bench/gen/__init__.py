"""Input generators: the graph and the update stream, from a seed."""
