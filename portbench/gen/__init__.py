"""Inputs made from a run's seed: examples, ratings, weights and batch
order. Each is a frozen copy kept here, so a change to the
port cannot move what the benchmark feeds it."""
