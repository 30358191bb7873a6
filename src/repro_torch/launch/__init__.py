"""Entry points of the port (counterpart of ``repro/launch``): the
prefill and single-token decode step builders over the dense KV cache
(``train``), the serving CLI (``serve``) and the streaming HTTP/SSE
server (``server``)."""
