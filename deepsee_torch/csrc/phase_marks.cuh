// Timer marks inside one launch, for scripts/kernel_phases.py.
//
// PHASE_MARK(k) compiles to nothing unless the source is built with
// -DDEEPSEE_PHASE_MARKS.  Then thread 0 of each block (of the first
// kPhaseBlocks) stores the card's global timer (%globaltimer, ns) at mark k,
// and the library exports phase_marks_read (copy the [block][mark] table to
// the host) and phase_marks_clear (zero it).  A timer read costs a few tens
// of ns.
#pragma once

#ifdef DEEPSEE_PHASE_MARKS
constexpr int kPhaseBlocks = 8192;
constexpr int kPhaseMarks = 16;
__device__ unsigned long long g_phase_marks[kPhaseBlocks][kPhaseMarks];

#define PHASE_MARK(k)                                                              \
  do {                                                                             \
    const unsigned block_ = blockIdx.x + blockIdx.y * gridDim.x;                   \
    if (threadIdx.x == 0 && block_ < kPhaseBlocks) {                               \
      unsigned long long t_;                                                       \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));                       \
      g_phase_marks[block_][k] = t_;                                               \
    }                                                                              \
  } while (0)

extern "C" int phase_marks_read(void* dst) {
  return static_cast<int>(cudaMemcpyFromSymbol(dst, g_phase_marks, sizeof(g_phase_marks)));
}

extern "C" int phase_marks_clear() {
  static unsigned long long zero[sizeof(g_phase_marks) / sizeof(unsigned long long)];
  return static_cast<int>(cudaMemcpyToSymbol(g_phase_marks, zero, sizeof(g_phase_marks)));
}
#else
#define PHASE_MARK(k) \
  do {                \
  } while (0)
#endif
