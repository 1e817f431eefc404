"""Serving front ends over the PyTorch engine: the coalescing query plane
(``query_plane``) and its JSON-lines TCP server (``server``), the twins of
``repro.serve.query_plane`` and ``repro.serve.server``."""
