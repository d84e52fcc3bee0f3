"""The work one call does, one module a call kind, named by a traffic
mix's ``call``: ``count(nnz, m, n, t)`` gives ``products`` (nonzero-vector
products, what ``gnnz_s`` counts), ``bytes`` and ``flops`` (the least
the card must move and compute, for the roofline).  Bytes count 4 a
float32 nonzero and each operand read once and each result written once;
no index array, whose size is the planner's choice.  Imports nothing of
the port."""
