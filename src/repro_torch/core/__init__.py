"""NDPage's translation layer: ``block_table`` (flat vs radix tables),
``translation_cache`` (the page-walk-cache analogue) and
``kv_page_manager`` (the host allocator and the KV pool primitives) on
the serving side, and the simulator's ``page_table`` (the PTE lines each
mechanism's walk touches)."""
