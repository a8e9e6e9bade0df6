"""The plain reference: FM SGD steps under adagrad and ALS sweeps in
plain torch, and the comparison that decides ``correct``.

It imports neither JAX, the JAX package nor anything of the port, and
takes nothing the program made: the harness gives it the inputs it gave
the program (examples, ratings, weights made again from the seed), and the
program's outputs only to judge them. It works out the batch order, the
distinct ids of each batch and the feature blocks itself. Run it after the
window has closed and the program's state is freed: it computes in
float64 on the card, in blocks of rows.
"""
