// A grid-wide barrier for a persistent cooperative launch, without -rdc
// (cooperative_groups' grid.sync needs relocatable device code): every
// CTA must be resident at once, which the launchers check before they
// launch. Shared by csrc/gru_stack.cu and csrc/gru_gates_p.cu.
#pragma once

// Every CTA's writes before the call are visible to every CTA after it.
// `target` grows by gridDim.x per barrier; the counter starts at 0.
__device__ __forceinline__ void grid_barrier(unsigned int* counter, unsigned int target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
    unsigned int seen;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(seen) : "l"(counter) : "memory");
    } while (seen < target);
  }
  __syncthreads();
}
