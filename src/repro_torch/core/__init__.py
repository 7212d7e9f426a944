"""CMoE core: profiling, clustering, partition, conversion, router, the
routed-expert engine and the CMoE FFN."""
