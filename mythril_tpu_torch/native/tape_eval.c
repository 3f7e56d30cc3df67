/* Native evaluator for the symbolic SSA tape.
 *
 * The witness search (mythril_tpu/smt/solver.py) evaluates the whole
 * tape under ~hundreds of candidate assignments per query; the Python
 * big-int evaluator (smt/eval.py evaluate()) is that loop's hot path.
 * This is the same semantics on 4x64-bit limbs: EVM wrap-around
 * arithmetic, signed ops by two's complement, and exact keccak-256 for
 * hash chains. The reference spends the analogous time inside Z3's C++
 * core (laser/smt Solver.check() ~unv, SURVEY.md section 2.2); here the
 * native tier is this evaluator plus the TPU propagation kernels.
 *
 * ABI (ctypes, see mythril_tpu/native/__init__.py):
 *   int tape_eval(int n, const int32_t* op, const int32_t* a,
 *                 const int32_t* b, const uint8_t* imm,  // n*32 BE
 *                 uint8_t* vals)                          // n*32 BE in/out
 * vals rows for FREE nodes are pre-seeded by the caller (leaf values
 * come from the Python Assignment); everything else is computed here.
 * Op codes MUST match symbolic/ops.py SymOp — pinned by the
 * differential tests in tests/test_native_eval.py.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* ---- SymOp (mirror of mythril_tpu/symbolic/ops.py) ---- */
enum {
    OP_NULL = 0, OP_CONST = 1, OP_FREE = 2,
    OP_ADD = 3, OP_SUB = 4, OP_MUL = 5, OP_DIV = 6, OP_SDIV = 7,
    OP_MOD = 8, OP_SMOD = 9, OP_EXP = 10, OP_SIGNEXTEND = 11,
    OP_LT = 12, OP_GT = 13, OP_SLT = 14, OP_SGT = 15, OP_EQ = 16,
    OP_ISZERO = 17, OP_AND = 18, OP_OR = 19, OP_XOR = 20, OP_NOT = 21,
    OP_BYTE = 22, OP_SHL = 23, OP_SHR = 24, OP_SAR = 25,
    OP_KECCAK_SEED = 26, OP_KECCAK_ABS = 27, OP_KECCAK = 28,
};

typedef struct { uint64_t w[4]; } u256; /* w[0] = least significant */

static void u_load(u256 *r, const uint8_t *be) {
    for (int i = 0; i < 4; i++) {
        uint64_t v = 0;
        const uint8_t *p = be + (3 - i) * 8;
        for (int k = 0; k < 8; k++) v = (v << 8) | p[k];
        r->w[i] = v;
    }
}

static void u_store(uint8_t *be, const u256 *a) {
    for (int i = 0; i < 4; i++) {
        uint64_t v = a->w[i];
        uint8_t *p = be + (3 - i) * 8;
        for (int k = 7; k >= 0; k--) { p[k] = (uint8_t)v; v >>= 8; }
    }
}

static void u_zero(u256 *r) { r->w[0] = r->w[1] = r->w[2] = r->w[3] = 0; }
static void u_one(u256 *r) { u_zero(r); r->w[0] = 1; }
static int u_is_zero(const u256 *a) {
    return !(a->w[0] | a->w[1] | a->w[2] | a->w[3]);
}
static int u_cmp(const u256 *a, const u256 *b) {
    for (int i = 3; i >= 0; i--) {
        if (a->w[i] < b->w[i]) return -1;
        if (a->w[i] > b->w[i]) return 1;
    }
    return 0;
}
static int u_is_neg(const u256 *a) { return (int)(a->w[3] >> 63); }

static void u_add(u256 *r, const u256 *a, const u256 *b) {
    unsigned __int128 c = 0;
    for (int i = 0; i < 4; i++) {
        c += (unsigned __int128)a->w[i] + b->w[i];
        r->w[i] = (uint64_t)c;
        c >>= 64;
    }
}

static void u_sub(u256 *r, const u256 *a, const u256 *b) {
    unsigned __int128 borrow = 0;
    for (int i = 0; i < 4; i++) {
        unsigned __int128 d =
            (unsigned __int128)a->w[i] - b->w[i] - (uint64_t)borrow;
        r->w[i] = (uint64_t)d;
        borrow = (d >> 64) ? 1 : 0;
    }
}

static void u_neg(u256 *r, const u256 *a) {
    u256 z; u_zero(&z); u_sub(r, &z, a);
}

static void u_mul(u256 *r, const u256 *a, const u256 *b) {
    uint64_t out[4] = {0, 0, 0, 0};
    for (int i = 0; i < 4; i++) {
        unsigned __int128 carry = 0;
        for (int j = 0; i + j < 4; j++) {
            unsigned __int128 cur =
                (unsigned __int128)a->w[i] * b->w[j] + out[i + j] + carry;
            out[i + j] = (uint64_t)cur;
            carry = cur >> 64;
        }
    }
    memcpy(r->w, out, 32);
}

static void u_shl_k(u256 *r, const u256 *a, unsigned k) {
    u256 out; u_zero(&out);
    if (k >= 256) { *r = out; return; }
    unsigned limb = k / 64, bits = k % 64;
    for (int i = 3; i >= 0; i--) {
        uint64_t v = 0;
        int src = i - (int)limb;
        if (src >= 0) {
            v = a->w[src] << bits;
            if (bits && src - 1 >= 0) v |= a->w[src - 1] >> (64 - bits);
        }
        out.w[i] = v;
    }
    *r = out;
}

static void u_shr_k(u256 *r, const u256 *a, unsigned k) {
    u256 out; u_zero(&out);
    if (k >= 256) { *r = out; return; }
    unsigned limb = k / 64, bits = k % 64;
    for (int i = 0; i < 4; i++) {
        uint64_t v = 0;
        unsigned src = i + limb;
        if (src < 4) {
            v = a->w[src] >> bits;
            if (bits && src + 1 < 4) v |= a->w[src + 1] << (64 - bits);
        }
        out.w[i] = v;
    }
    *r = out;
}

/* binary long division; b must be nonzero */
static void u_divmod(const u256 *a, const u256 *b, u256 *q, u256 *rem) {
    u256 r0, q0;
    u_zero(&r0); u_zero(&q0);
    for (int i = 255; i >= 0; i--) {
        u_shl_k(&r0, &r0, 1);
        r0.w[0] |= (a->w[i / 64] >> (i % 64)) & 1ULL;
        if (u_cmp(&r0, b) >= 0) {
            u_sub(&r0, &r0, b);
            q0.w[i / 64] |= 1ULL << (i % 64);
        }
    }
    *q = q0; *rem = r0;
}

/* shift amount saturated to 256 when any high limb is set */
static unsigned shift_amount(const u256 *a) {
    if (a->w[1] | a->w[2] | a->w[3] || a->w[0] >= 256) return 256;
    return (unsigned)a->w[0];
}

/* ---- keccak-256 (keccak-f[1600], rate 136, pad 0x01..0x80) ---- */

static const uint64_t KRC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808aULL,
    0x8000000080008000ULL, 0x000000000000808bULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008aULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000aULL,
    0x000000008000808bULL, 0x800000000000008bULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800aULL, 0x800000008000000aULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL,
};

static inline uint64_t rotl64(uint64_t x, int s) {
    return (x << s) | (x >> (64 - s));
}

static void keccakf(uint64_t st[25]) {
    static const int rotc[24] = {1, 3, 6, 10, 15, 21, 28, 36, 45, 55, 2, 14,
                                 27, 41, 56, 8, 25, 43, 62, 18, 39, 61, 20, 44};
    static const int piln[24] = {10, 7, 11, 17, 18, 3, 5, 16, 8, 21, 24, 4,
                                 15, 23, 19, 13, 12, 2, 20, 14, 22, 9, 6, 1};
    uint64_t bc[5], t;
    for (int round = 0; round < 24; round++) {
        for (int i = 0; i < 5; i++)
            bc[i] = st[i] ^ st[i + 5] ^ st[i + 10] ^ st[i + 15] ^ st[i + 20];
        for (int i = 0; i < 5; i++) {
            t = bc[(i + 4) % 5] ^ rotl64(bc[(i + 1) % 5], 1);
            for (int j = 0; j < 25; j += 5) st[j + i] ^= t;
        }
        t = st[1];
        for (int i = 0; i < 24; i++) {
            int j = piln[i];
            bc[0] = st[j];
            st[j] = rotl64(t, rotc[i]);
            t = bc[0];
        }
        for (int j = 0; j < 25; j += 5) {
            for (int i = 0; i < 5; i++) bc[i] = st[j + i];
            for (int i = 0; i < 5; i++)
                st[j + i] ^= (~bc[(i + 1) % 5]) & bc[(i + 2) % 5];
        }
        st[0] ^= KRC[round];
    }
}

static void keccak256(const uint8_t *data, size_t len, uint8_t out[32]) {
    uint64_t st[25];
    uint8_t block[136];
    memset(st, 0, sizeof(st));
    while (len >= 136) {
        for (int i = 0; i < 17; i++) {
            uint64_t v = 0;
            for (int k = 7; k >= 0; k--) v = (v << 8) | data[i * 8 + k];
            st[i] ^= v;
        }
        keccakf(st);
        data += 136;
        len -= 136;
    }
    memset(block, 0, sizeof(block));
    memcpy(block, data, len);
    block[len] = 0x01;
    block[135] |= 0x80;
    for (int i = 0; i < 17; i++) {
        uint64_t v = 0;
        for (int k = 7; k >= 0; k--) v = (v << 8) | block[i * 8 + k];
        st[i] ^= v;
    }
    keccakf(st);
    for (int i = 0; i < 4; i++) {
        uint64_t v = st[i];
        for (int k = 0; k < 8; k++) { out[i * 8 + k] = (uint8_t)v; v >>= 8; }
    }
}

/* ---- keccak chain bookkeeping ---- */

typedef struct {
    uint8_t *buf;
    uint32_t len;     /* bytes accumulated */
    uint32_t declen;  /* declared hash length (SEED imm low 32) */
    uint32_t start;   /* start offset in the first word (SEED imm high 32) */
} chain_t;

int tape_eval(int n, const int32_t *op, const int32_t *a, const int32_t *b,
              const uint8_t *imm, uint8_t *vals) {
    chain_t *chains = (chain_t *)calloc((size_t)n, sizeof(chain_t));
    if (!chains) return -1;
    int rc = 0;

    for (int i = 1; i < n; i++) {
        int o = op[i];
        int ia = a[i], ib = b[i];
        u256 va, vb, r;

        switch (o) {
        case OP_NULL:
        case OP_FREE: /* pre-seeded by the caller; a/b are (kind, index) */
            continue;
        case OP_CONST:
            memcpy(vals + (size_t)i * 32, imm + (size_t)i * 32, 32);
            continue;
        case OP_KECCAK_SEED: {
            u256 vi; u_load(&vi, imm + (size_t)i * 32);
            chains[i].buf = NULL;
            chains[i].len = 0;
            chains[i].declen = (uint32_t)(vi.w[0] & 0xFFFFFFFFULL);
            chains[i].start = (uint32_t)(vi.w[0] >> 32);
            continue;
        }
        case OP_KECCAK_ABS: {
            if (ia < 0 || ia >= n || ib < 0 || ib >= n) { rc = -2; goto done; }
            chain_t *p = &chains[ia];
            uint32_t nl = p->len + 32;
            uint8_t *nb = (uint8_t *)malloc(nl);
            if (!nb) { rc = -1; goto done; }
            if (p->len) memcpy(nb, p->buf, p->len);
            if (ib)
                memcpy(nb + p->len, vals + (size_t)ib * 32, 32);
            else
                memcpy(nb + p->len, imm + (size_t)i * 32, 32);
            chains[i].buf = nb;
            chains[i].len = nl;
            chains[i].declen = p->declen;
            chains[i].start = p->start;
            continue;
        }
        case OP_KECCAK: {
            if (ia < 0 || ia >= n) { rc = -2; goto done; }
            chain_t *c = &chains[ia];
            uint32_t s = c->start, l = c->declen;
            if (s > c->len) s = c->len;
            if (s + l > c->len) l = c->len - s;
            keccak256(c->buf ? c->buf + s : (const uint8_t *)"", l,
                      vals + (size_t)i * 32);
            continue;
        }
        default:
            break;
        }

        /* value ops: a/b are node ids into vals */
        if (ia < 0 || ia >= n || ib < 0 || ib >= n) { rc = -2; break; }
        u_load(&va, vals + (size_t)ia * 32);
        u_load(&vb, vals + (size_t)ib * 32);
        u_zero(&r);

        switch (o) {
        case OP_ADD: u_add(&r, &va, &vb); break;
        case OP_SUB: u_sub(&r, &va, &vb); break;
        case OP_MUL: u_mul(&r, &va, &vb); break;
        case OP_DIV:
            if (!u_is_zero(&vb)) { u256 rem; u_divmod(&va, &vb, &r, &rem); }
            break;
        case OP_SDIV:
            if (!u_is_zero(&vb)) {
                u256 aa = va, ab = vb, rem;
                int na = u_is_neg(&va), nb_ = u_is_neg(&vb);
                if (na) u_neg(&aa, &va);
                if (nb_) u_neg(&ab, &vb);
                u_divmod(&aa, &ab, &r, &rem);
                if (na != nb_) u_neg(&r, &r);
            }
            break;
        case OP_MOD:
            if (!u_is_zero(&vb)) { u256 q; u_divmod(&va, &vb, &q, &r); }
            break;
        case OP_SMOD:
            if (!u_is_zero(&vb)) {
                u256 aa = va, ab = vb, q;
                int na = u_is_neg(&va);
                if (na) u_neg(&aa, &va);
                if (u_is_neg(&vb)) u_neg(&ab, &vb);
                u_divmod(&aa, &ab, &q, &r);
                if (na) u_neg(&r, &r);
            }
            break;
        case OP_EXP: {
            u256 acc, base = va;
            u_one(&acc);
            for (int k = 0; k < 256; k++) {
                if ((vb.w[k / 64] >> (k % 64)) & 1ULL) u_mul(&acc, &acc, &base);
                u_mul(&base, &base, &base);
            }
            r = acc;
            break;
        }
        case OP_SIGNEXTEND:
            if (!(va.w[1] | va.w[2] | va.w[3]) && va.w[0] < 31) {
                unsigned bit = 8u * (unsigned)va.w[0] + 7u;
                r = vb;
                if ((vb.w[bit / 64] >> (bit % 64)) & 1ULL) {
                    /* set all bits above `bit` */
                    for (unsigned k = bit + 1; k < 256; k++)
                        r.w[k / 64] |= 1ULL << (k % 64);
                } else {
                    for (unsigned k = bit + 1; k < 256; k++)
                        r.w[k / 64] &= ~(1ULL << (k % 64));
                }
            } else {
                r = vb;
            }
            break;
        case OP_LT: if (u_cmp(&va, &vb) < 0) r.w[0] = 1; break;
        case OP_GT: if (u_cmp(&va, &vb) > 0) r.w[0] = 1; break;
        case OP_SLT: {
            int na = u_is_neg(&va), nb_ = u_is_neg(&vb);
            int lt = (na != nb_) ? na : (u_cmp(&va, &vb) < 0);
            if (lt) r.w[0] = 1;
            break;
        }
        case OP_SGT: {
            int na = u_is_neg(&va), nb_ = u_is_neg(&vb);
            int gt = (na != nb_) ? nb_ : (u_cmp(&va, &vb) > 0);
            if (gt) r.w[0] = 1;
            break;
        }
        case OP_EQ: if (u_cmp(&va, &vb) == 0) r.w[0] = 1; break;
        case OP_ISZERO: if (u_is_zero(&va)) r.w[0] = 1; break;
        case OP_AND:
            for (int k = 0; k < 4; k++) r.w[k] = va.w[k] & vb.w[k];
            break;
        case OP_OR:
            for (int k = 0; k < 4; k++) r.w[k] = va.w[k] | vb.w[k];
            break;
        case OP_XOR:
            for (int k = 0; k < 4; k++) r.w[k] = va.w[k] ^ vb.w[k];
            break;
        case OP_NOT:
            for (int k = 0; k < 4; k++) r.w[k] = ~va.w[k];
            break;
        case OP_BYTE:
            if (!(va.w[1] | va.w[2] | va.w[3]) && va.w[0] < 32) {
                unsigned sh = 8u * (31u - (unsigned)va.w[0]);
                u256 t; u_shr_k(&t, &vb, sh);
                r.w[0] = t.w[0] & 0xFFULL;
            }
            break;
        case OP_SHL: u_shl_k(&r, &vb, shift_amount(&va)); break;
        case OP_SHR: u_shr_k(&r, &vb, shift_amount(&va)); break;
        case OP_SAR: {
            unsigned k = shift_amount(&va);
            int neg = u_is_neg(&vb);
            if (k >= 256) {
                if (neg) { r.w[0] = r.w[1] = r.w[2] = r.w[3] = ~0ULL; }
            } else {
                u_shr_k(&r, &vb, k);
                if (neg && k) { /* fill the top k bits with sign */
                    for (unsigned bit = 256 - k; bit < 256; bit++)
                        r.w[bit / 64] |= 1ULL << (bit % 64);
                }
            }
            break;
        }
        default:
            /* unknown op: FAIL so evaluate() falls back to the Python
             * path — a SymOp added there but not here must not yield
             * silently-zero native values */
            rc = -3;
            goto done;
        }
        u_store(vals + (size_t)i * 32, &r);
    }

done:
    for (int i = 0; i < n; i++)
        if (chains[i].buf) free(chains[i].buf);
    free(chains);
    return rc;
}
