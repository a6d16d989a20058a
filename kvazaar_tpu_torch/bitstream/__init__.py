"""Host bitstream layer of the port.  Headers, CABAC contexts and the
Python serializer are shared with kvazaar_tpu.bitstream (jax-free);
only the native serializer's build and binding live here."""
