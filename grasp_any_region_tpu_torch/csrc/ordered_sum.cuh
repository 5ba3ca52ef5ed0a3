// A sum across the CTAs of a grid without a grid barrier, in a fixed order:
// the ordered last-arriver sum of kernels 21 / 23 (decode_mlp_sm90.cu) and 22
// (decode_attn_wo_sm90.cu).
//
// Each CTA stores its fp32 partial of an output slice into its slot of a
// workspace and, after a barrier over the storing threads, one thread fences
// (release, fence.acq_rel.gpu) and adds one to the counter of the slot's
// group (kSumGroup consecutive slots). The CTA whose addition completes a
// group fences again
// (acquire), sets that counter back to 0 and sums the group's slots in slot
// order: into the group's own slot, or, where the slice has one group, plus
// the residual x, rounded once to bf16, into the output. With more groups it
// arrives at the slice's top counter, and the CTA that completes it sums the
// group slots in group order, adds x and rounds once. So no CTA waits for
// another, the grid need not be resident at once, the bits do not depend on
// which CTA arrives when, and every counter is 0 again after a launch (a
// second launch or a CUDA-graph replay finds them so). Launches that share
// the counters must be ordered on one stream.
//
// The order of the sum: groups of kSumGroup slots, each added in slot order,
// then the groups in order (ops/decode_megakernel.py:ordered_sum_plain
// mirrors it). Two levels keep the work of the CTA that arrives last small:
// it reads at most kSumGroup slots of its group and the group sums.
#pragma once

#include "common.cuh"

namespace gar {

constexpr int kSumGroup = 8;

// The slices of one launch: slot s of slice i, row r, column c at ws[s *
// slot_stride + r * ws_ld + c] (c from the slice's first column), `slots`
// slots, then one slot per group for the group sums (more than one group);
// a slice's counters at counters[i * (groups + 1)], the top one last.
struct SumPlan {
  float* ws;
  long long slot_stride, ws_ld;
  int slots, rows;
  const bf16* x;  // [rows][io_ld]
  bf16* out;
  long long io_ld;
  unsigned* counters;

  __device__ __forceinline__ int groups() const { return (slots + kSumGroup - 1) / kSumGroup; }
  __device__ __forceinline__ unsigned* counter(int slice, int g) const {
    return counters + static_cast<long long>(slice) * (groups() + 1) + g;
  }
};

// Release (acquire) ordering at the GPU's scope, cumulative over the writes
// a barrier ordered before it.
__device__ __forceinline__ void fence_acq_rel_gpu() {
  asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
}

// One thread, after a barrier that follows the stores this arrival covers:
// the release fence and the arrival at the slot's group. Returns the ticket
// (the counter's value before), which need not be read at once.
__device__ __forceinline__ unsigned sum_arrive(const SumPlan& p, int slice, int slot) {
  fence_acq_rel_gpu();
  return atomicAdd(p.counter(slice, slot / kSumGroup), 1u);
}

// True if `ticket` completed the group of `slot`; then the group's counter
// is 0 again and this thread has fenced (acquire) before any read of it.
__device__ __forceinline__ bool sum_completed(const SumPlan& p, int slice, int slot,
                                              unsigned ticket) {
  const int g = slot / kSumGroup;
  if (ticket != static_cast<unsigned>(min(kSumGroup, p.slots - g * kSumGroup) - 1)) return false;
  fence_acq_rel_gpu();
  atomicExch(p.counter(slice, g), 0u);
  return true;
}

// ITEMS units (row r[h], 4 columns at c[h]; valid[h]) of one pass: the sum
// of slots [s0, s0 + n) (n <= kSumGroup) in slot order, with every load of
// every unit issued before the first add (summed a unit at a time, kernel
// 23 at B = 24 took 0.146 ms, not 0.121); then either the group sum stored
// at slot `dst_slot`, or, with x, x + the sum rounded once into out.
template <int ITEMS>
__device__ __forceinline__ void sum_units(const SumPlan& p, int s0, int n, const int (&r)[ITEMS],
                                          const int (&c)[ITEMS], const bool (&valid)[ITEMS],
                                          int dst_slot, bool final_) {
  float4 v[ITEMS][kSumGroup];
  uint2 xv[ITEMS];
#pragma unroll
  for (int h = 0; h < ITEMS; ++h) {
    if (!valid[h]) continue;
    const float* at = p.ws + r[h] * p.ws_ld + c[h];
#pragma unroll
    for (int k = 0; k < kSumGroup; ++k)
      if (k < n) v[h][k] = __ldcg(reinterpret_cast<const float4*>(at + (s0 + k) * p.slot_stride));
    if (final_) xv[h] = *reinterpret_cast<const uint2*>(p.x + r[h] * p.io_ld + c[h]);
  }
#pragma unroll
  for (int h = 0; h < ITEMS; ++h) {
    if (!valid[h]) continue;
    float4 acc = v[h][0];
#pragma unroll
    for (int k = 1; k < kSumGroup; ++k)
      if (k < n) acc.x += v[h][k].x, acc.y += v[h][k].y, acc.z += v[h][k].z, acc.w += v[h][k].w;
    if (final_) {
      const float2 x01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xv[h].x));
      const float2 x23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xv[h].y));
      uint2 o;
      *reinterpret_cast<__nv_bfloat162*>(&o.x) = __floats2bfloat162_rn(x01.x + acc.x, x01.y + acc.y);
      *reinterpret_cast<__nv_bfloat162*>(&o.y) = __floats2bfloat162_rn(x23.x + acc.z, x23.y + acc.w);
      *reinterpret_cast<uint2*>(p.out + r[h] * p.io_ld + c[h]) = o;
    } else {
      __stcg(reinterpret_cast<float4*>(p.ws + dst_slot * p.slot_stride + r[h] * p.ws_ld + c[h]),
             acc);
    }
  }
}

// Every thread of the group (NTHREADS threads, barrier `sync`): the sums of
// the slices this CTA completed with `slot`. list[0 .. n) (shared memory)
// names them and col0(i) gives slice i's first column; each slice is `cols`
// columns (a multiple of 4) wide. flags: shared memory for n ints. The group
// sums (or, with one group, the outputs), then the top arrivals, then the
// outputs of the slices this CTA completes at the top.
template <int NTHREADS, int ITEMS, typename Col0, typename Sync>
__device__ void sum_finish(const SumPlan& p, int slot, int cols, int* list, int n, int* flags,
                           Col0 col0, int tid, Sync sync) {
  const int groups = p.groups(), g = slot / kSumGroup, per_row = cols / 4;
  const int units = p.rows * per_row, g0 = g * kSumGroup, gn = min(kSumGroup, p.slots - g0);
  // item e: slice list[e / units], unit (row, 4 columns) e % units; ITEMS
  // items a thread at a time
  auto pass = [&](int count, int s0, int sn, int dst_slot, bool final_) {
    for (int e0 = tid; e0 < count * units; e0 += ITEMS * NTHREADS) {
      int r[ITEMS], c[ITEMS];
      bool valid[ITEMS];
#pragma unroll
      for (int h = 0; h < ITEMS; ++h) {
        const int e = e0 + h * NTHREADS;
        valid[h] = e < count * units;
        const int i = list[valid[h] ? e / units : 0], u = e % units;
        r[h] = u / per_row;
        c[h] = col0(i) + 4 * (u % per_row);
      }
      sum_units<ITEMS>(p, s0, sn, r, c, valid, dst_slot, final_);
    }
  };
  pass(n, g0, gn, p.slots + g, groups == 1);
  if (groups == 1) return;
  sync();  // every group sum is stored: released by the arriving threads' fences
  if (tid < n) {
    const int i = list[tid];
    unsigned* top = p.counter(i, groups);
    fence_acq_rel_gpu();
    const bool last = atomicAdd(top, 1u) == static_cast<unsigned>(groups - 1);
    if (last) {
      fence_acq_rel_gpu();
      atomicExch(top, 0u);
    }
    flags[tid] = last;
  }
  sync();
  if (tid == 0) {  // the slices completed at the top, compacted
    int m = 0;
    for (int k = 0; k < n; ++k)
      if (flags[k]) list[m++] = list[k];
    flags[0] = m;
  }
  sync();
  if (groups <= kSumGroup) {
    pass(flags[0], p.slots, groups, 0, true);
    return;
  }
  for (int e = tid; e < flags[0] * units; e += NTHREADS) {  // more groups: one unit at a time
    const int i = list[e / units], u = e % units, r = u / per_row, c = col0(i) + 4 * (u % per_row);
    const float* at = p.ws + r * p.ws_ld + c;
    float4 acc = __ldcg(reinterpret_cast<const float4*>(at + p.slots * p.slot_stride));
    for (int k = 1; k < groups; ++k) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(at + (p.slots + k) * p.slot_stride));
      acc.x += v.x, acc.y += v.y, acc.z += v.z, acc.w += v.w;
    }
    const float2 x01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p.x + r * p.io_ld + c));
    const float2 x23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p.x + r * p.io_ld + c + 2));
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(p.out + r * p.io_ld + c);
    o[0] = __floats2bfloat162_rn(x01.x + acc.x, x01.y + acc.y);
    o[1] = __floats2bfloat162_rn(x23.x + acc.z, x23.y + acc.w);
  }
}

}  // namespace gar
