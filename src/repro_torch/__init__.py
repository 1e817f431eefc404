"""PyTorch / CUDA port of the EPSM packed string matcher, for NVIDIA Hopper.

The twin of the JAX package ``repro``, which stays the reference.  It imports
torch and numpy only.  Ported so far: ``core.packing``, ``core.epsm``
(find / count / positions through the EPSMa/b/c CUDA kernels),
``core.engine`` and ``core.multipattern`` (P patterns x B texts, with the
multi-pattern CUDA kernel on the full-mask EPSMb route), ``approx``
(k-mismatch matching, with the approx CUDA kernel on the full-mask route),
``core.stream`` (bounded-memory streaming, with the fused megascan CUDA
kernel), ``core.automaton`` (the engine's dictionary-scale Aho-Corasick
route, with the acscan CUDA kernel), ``serve`` (the coalescing query plane
and its JSON-lines server), ``obs`` and ``data.corpus``; ``core.remote_source``,
``core.shard_stream``, ``core.distributed``, ``dist`` and ``launch.mesh``
(sharded, fault-tolerant streaming); and the byte-level LM serving path:
``models`` (common blocks, attention with the int8 KV cache, MoE, the
transformer's prefill and decode steps, ``convert`` from the reference's
parameters), ``configs`` (the ten architectures), ``data.pipeline``
(blocklist filter and dedup), ``serve.engine`` (``StopScanner``,
``ServeEngine``) and ``launch.serve``; LM training (``train``,
``launch.train``); and the recsys and GNN families (``models.embedding``,
``models.recsys``, ``models.gnn``, ``data.graph``, ``data.recsys_data``).
"""
