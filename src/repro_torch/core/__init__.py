"""ESP core (PyTorch): striped ring prefill replay, packed prefill and
multi-master paged decode attention impls."""
