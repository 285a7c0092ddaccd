// Batched greedy NMS keep mask, for sm_90a.
//
// Replaces detectron_tpu/ops/pallas/nms_kernel.py::nms_keep_mask (its
// kernel body _kernel, nms_kernel.py:26-87). L independent lanes, each of
// N boxes in descending score order: a valid box is kept unless a kept,
// earlier box of its lane overlaps it with IoU > thr (Detectron's +1 rule).
// Invalid boxes never pivot and never survive; each lane loops only to its
// last valid index + 1, so invalid holes mid-lane are safe.
//
// Design: one CTA per lane. The lane's boxes and keep flags are staged in
// shared memory (17 bytes per box); the greedy recurrence is sequential in
// the pivot i, and each alive pivot suppresses the later boxes of its lane
// with threads striding over j, then a __syncthreads(). A dead pivot is
// skipped without a barrier: keep[i] is only written while an earlier pivot
// runs, and every such iteration ends with a barrier, so all threads read
// the same value and take the same branch.
//
// Bound: latency, not bandwidth. A lane of N = 1000 boxes is 16 KB, and
// the chain of up to N barriers dominates; lanes run in parallel, one per
// CTA (RPN: L = B lanes per FPN level; detection tail: L = B * 80).
//
// The IoU is computed in f32 exactly as the Pallas kernel writes it, with
// round-to-nearest intrinsics so that no multiply-add is contracted: the
// keep mask matches the plain PyTorch version bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float box_area(float x1, float y1, float x2,
                                          float y2) {
  return __fmul_rn(__fadd_rn(__fsub_rn(x2, x1), 1.0f),
                   __fadd_rn(__fsub_rn(y2, y1), 1.0f));
}

__global__ void __launch_bounds__(kThreads)
nms_keep_mask_kernel(const float* __restrict__ boxes,
                     const uint8_t* __restrict__ valid,
                     uint8_t* __restrict__ keep, int n, float thr) {
  extern __shared__ float4 smem[];
  float4* sb = smem;
  uint8_t* sk = reinterpret_cast<uint8_t*>(sb + n);
  __shared__ int last;

  const size_t lane = blockIdx.x;
  const float* lb = boxes + lane * n * 4;
  const uint8_t* lv = valid + lane * n;
  if (threadIdx.x == 0) last = 0;
  __syncthreads();

  int my_last = 0;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    sb[j] = make_float4(lb[4 * j], lb[4 * j + 1], lb[4 * j + 2],
                        lb[4 * j + 3]);
    const uint8_t v = lv[j] != 0;
    sk[j] = v;
    if (v) my_last = j + 1;
  }
  atomicMax(&last, my_last);
  __syncthreads();
  const int n_iter = last;

  for (int i = 0; i < n_iter; ++i) {
    if (!sk[i]) continue;
    const float4 b = sb[i];
    const float barea = box_area(b.x, b.y, b.z, b.w);
    for (int j = i + 1 + threadIdx.x; j < n_iter; j += blockDim.x) {
      if (!sk[j]) continue;
      const float4 o = sb[j];
      const float area = box_area(o.x, o.y, o.z, o.w);
      const float iw = fmaxf(
          __fadd_rn(__fsub_rn(fminf(o.z, b.z), fmaxf(o.x, b.x)), 1.0f),
          0.0f);
      const float ih = fmaxf(
          __fadd_rn(__fsub_rn(fminf(o.w, b.w), fmaxf(o.y, b.y)), 1.0f),
          0.0f);
      const float inter = __fmul_rn(iw, ih);
      const float iou =
          __fdiv_rn(inter, __fsub_rn(__fadd_rn(area, barea), inter));
      if (iou > thr) sk[j] = 0;
    }
    __syncthreads();
  }

  uint8_t* lk = keep + lane * n;
  for (int j = threadIdx.x; j < n; j += blockDim.x) lk[j] = sk[j];
}

}  // namespace

// boxes: (L, N, 4) f32; valid, keep: (L, N) bytes (torch.bool). Launches on
// `stream` and returns cudaGetLastError().
extern "C" int nms_keep_mask_launch(const void* boxes, const void* valid,
                                    void* keep, int lanes, int n, float thr,
                                    void* stream) {
  if (lanes > 0 && n > 0) {
    const size_t smem = static_cast<size_t>(n) * (sizeof(float4) + 1);
    nms_keep_mask_kernel<<<lanes, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(boxes),
        static_cast<const uint8_t*>(valid), static_cast<uint8_t*>(keep), n,
        thr);
  }
  return static_cast<int>(cudaGetLastError());
}
