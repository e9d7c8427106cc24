"""Patch a copy of csrc/schur_pairs.cu to the dense product's accumulation:
each block's terms summed from zero with fused multiply-adds, component by
component (acc = fma(y2, w2, fma(y1, w1, fma(y0, w0, acc)))), then S = A
- acc once at the end; E the same. (An experiment on the sweeps of the
refine cells, call 13. The kernel has rounded this way since, so the
patch no longer applies to the source.)

    python3 _archive/k4/variant_g.py TREE
"""
import os
import sys

p = os.path.join(sys.argv[1], "linearsfm_tpu_torch", "csrc", "schur_pairs.cu")
s = open(p).read()
reps = [
    ("""  return __fsub_rn(s, __fmaf_rn(a2, b2, __fmaf_rn(a1, b1, __fmul_rn(a0, b0))));""",
     """  return __fmaf_rn(a2, b2, __fmaf_rn(a1, b1, __fmaf_rn(a0, b0, s)));"""),
    ("""  float e = e_warp && lane < 6 ? a.E[6 * r + lane] : 0.f;""",
     """  float e = 0.f;"""),
    ("""          const float2 x = b2[k];
          s[i * 6 + 2 * k] = x.x;
          s[i * 6 + 2 * k + 1] = x.y;""",
     """          s[i * 6 + 2 * k] = 0.f;
          s[i * 6 + 2 * k + 1] = 0.f;"""),
    ("""        b2[k] = make_float2(s[i * 6 + 2 * k], s[i * 6 + 2 * k + 1]);""",
     """      {
        const float2 x = b2[k];
        b2[k] = make_float2(__fsub_rn(x.x, s[i * 6 + 2 * k]),
                            __fsub_rn(x.y, s[i * 6 + 2 * k + 1]));
      }"""),
    ("""  if (e_warp && lane < 6) a.E[6 * r + lane] = e;""",
     """  if (e_warp && lane < 6) a.E[6 * r + lane] = __fsub_rn(a.E[6 * r + lane], e);"""),
]
for x, y in reps:
    assert s.count(x) == 1, x
    s = s.replace(x, y)
open(p, "w").write(s)
print("variant g written")
