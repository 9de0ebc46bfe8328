"""Host codec core of the port: the parts of ``metalhuffman_tpu.core`` that
the port runs, kept as its own copies (tests hold each equal to its
original), plus the torch counterparts of the JAX block and delta helpers."""
