"""The operations and bytes each kernel's work needs, from its shapes,
and the least time the chip could take for it (``bound_s``)."""
