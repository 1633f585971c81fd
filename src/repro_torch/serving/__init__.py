"""Serving engine, sampler, batching, caches and the paged allocator."""
