"""Core runtime pieces of the port: the flag registry, the Tensor, its
dtypes, places, random state, op boundary and backward, and the CUDA
graph capture the serving programs and `to_static` share."""
