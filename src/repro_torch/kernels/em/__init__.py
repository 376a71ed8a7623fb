"""The fixed-dt SDE ensemble kernel (GPUEM / GPUSIEA): binding (`kernel`),
public wrapper (`ops`) and lanes oracle (`ref`)."""
