// The call-size tile choice of the fused round trip, one policy for K3 at
// M >= 32 (cached_conv.cu, rtc_choice) and K3t (cached_conv_tc.cu,
// rt_tc_choice); kernels/cached_conv.py's _rt_tile_choice mirrors it.
//
// A call of B rows of T_out output steps is a whole file from n_sms * 16
// m16 output tiles on: it runs persistent blocks over the kernel's
// whole-file tile (rt_call_tile returns 0).  A smaller call (host blocks)
// takes tiles of 64, 32 or 16 output steps, the largest that gives at
// least n_sms / 4 blocks, one tile a cluster of `cluster` blocks (1 where
// the kernel runs no clusters): it is blocks, not tiles, that fill the
// card.

#pragma once

constexpr int kRtPersistM16 = 16;
constexpr int kRtSmall[3] = {16, 32, 64};
constexpr int kRtFillDiv = 4;

inline int rt_call_tile(int B, int T_out, int n_sms, int cluster) {
  if ((long long)B * ((T_out + 15) / 16) >= (long long)n_sms * kRtPersistM16)
    return 0;
  int Tt = kRtSmall[2];
  while (Tt > kRtSmall[0] &&
         (long long)B * ((T_out + Tt - 1) / Tt) * cluster <
             n_sms / kRtFillDiv)
    Tt /= 2;
  return Tt;
}
