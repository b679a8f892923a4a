"""Request-side image packing."""
