"""NDPage's serving-side translation layer: ``block_table`` (flat vs
radix tables), ``translation_cache`` (the page-walk-cache analogue) and
``kv_page_manager`` (the host allocator and the KV pool primitives).
The simulator's ``page_table`` belongs to the simulator slice."""
