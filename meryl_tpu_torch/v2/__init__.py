"""meryl2: the generalized (kmer, value, label) model with an
assign/select algebra (counterpart of meryl_tpu/v2).  The v1 operations
are aliases of this model (meryl2's reference.rst:253-372)."""
