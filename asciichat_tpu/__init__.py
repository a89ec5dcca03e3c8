"""asciichat_tpu — an accelerator-first (JAX/XLA) framework with the capabilities of ascii-chat.

The reference (zfogg/ascii-chat) is a C terminal video-chat system. This framework
re-implements its capabilities accelerator-first:

- the per-frame media path (resize -> luma -> quantize -> glyph map -> ANSI emission)
  runs as batched, fused XLA kernels over ``uint8 [B, H, W, 3]`` frames
  resident in device memory (reference: lib/video/ascii/*, lib/video/rgba/image.c),
- the inherently sequential ANSI byte grammar is emitted on the host by a
  multithreaded C++ table-walker fed by fixed-shape device "cell records"
  (reference: lib/video/ascii/output_buffer.c, lib/video/terminal/ansi.c),
- the server's N-client grid compositor is one batched kernel per tick
  (reference: src/server/stream.c),
- audio mixing (duck/compress/soft-clip) is a batched JAX op
  (reference: lib/audio/mixer.c),
- multi-device scaling shards the client/frame batch over a ``jax.sharding.Mesh``
  (collectives inserted by XLA), not per-client threads.

Output is byte-exact with the reference's scalar renderers (the production
oracle, see SURVEY.md Appendix A).
"""

__version__ = "0.1.0"

from asciichat_tpu.render.types import (  # noqa: F401
    ColorLevel,
    RenderMode,
    TerminalCapabilities,
)
