"""LM model stack: layers, attention, the decoder assembly and the
prefill/decode steps (the reference's ``models/``).  MoE, RG-LRU and RWKV6
carry their parameter shapes only; their forwards are ROADMAP item 13b."""
