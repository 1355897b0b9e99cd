"""LM model stack: layers, attention, the MoE FFN, the RG-LRU and RWKV6
blocks, the decoder assembly and the prefill/decode steps (the reference's
``models/``)."""
