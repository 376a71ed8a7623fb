"""The fused explicit-RK ensemble kernel: binding (`kernel`), public wrapper
(`ops`) and independent oracle (`ref`)."""
