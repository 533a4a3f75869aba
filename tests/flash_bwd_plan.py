"""A copy of K13-bwd's D = 256 dK/dV item plan for the tests: the CPU
tests emulate the kernel's schedule under it, and the card test holds the
library's plan (``flash_attn_bwd_scratch``) to it. Imports neither JAX nor
the JAX package, so the card tests can import it."""


def bwd_plan_d256(b: int, t: int, hq: int, hkv: int, sms: int):
    """K13-bwd's dK/dV plan at bf16 and the 256 template
    (``mxq_tpu_torch/csrc/flash_attn_bwd.cu`` ``plan_d256``, which the card
    runs): (pairs, splits). Items are 64 keys (nk =
    ceil(T / 64) key tiles) of one kv head and batch row, a key tile's item
    walking the nk - kt query tiles of each of its query heads; ``pairs``
    puts key tiles kt and nk - 1 - kt in one item (nk + 1 query tiles a
    head, the middle tile alone when nk is odd), ``splits`` cuts each kv
    head's G query heads over that many blocks. Of both pairings and each
    divisor of G, the plan with the least max(the longest item's tiles,
    all tiles over the blocks) wins, splits > 1 only where the items fit
    ``sms`` blocks (one wave); ties go to no pairs and fewer splits."""
    nk, g, kv = -(-t // 64), hq // hkv, hkv * b
    tiles = g * kv * nk * (nk + 1) // 2
    best = None
    for pair in (0, 1):
        units = (nk + 1) // 2 if pair else nk
        length = nk + 1 if pair and nk > 1 else nk
        for d in (d for d in range(1, g + 1) if g % d == 0):
            items = units * kv * d
            if d > 1 and items > sms:
                break
            blocks = min(items, sms)
            est = max(length * (g // d), -(-tiles // blocks))
            if best is None or est < best[0]:
                best = (est, bool(pair), d)
    return best[1], best[2]
