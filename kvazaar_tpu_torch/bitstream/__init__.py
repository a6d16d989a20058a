"""Host bitstream layer of the port: bit I/O, CABAC, contexts, headers
and the Python serializer (copies of kvazaar_tpu.bitstream's jax-free
modules, imports rewritten), plus the native serializer's build and
binding."""
