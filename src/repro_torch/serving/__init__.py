"""Serving engine, sampler, batching, caches, the paged allocator, the
multi-tenant model pool and scheduler, and per-tenant latency metrics."""
