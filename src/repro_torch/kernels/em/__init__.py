"""The SDE ensemble kernels: the fixed-dt kernel (GPUEM / GPUSIEA; binding
`kernel`, public wrapper `ops`, lanes oracle `ref`) and the adaptive kernel
on the virtual Brownian tree (binding `adaptive`, wrapper
`ops.solve_sde_adaptive_kernel`, oracle `ref.solve_adaptive_lanes`)."""
