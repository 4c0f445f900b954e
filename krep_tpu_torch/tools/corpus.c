/* bench.py's corpus lines (gen_corpus, gen_corpus_ing), replayed from the
 * raw outputs of numpy's PCG64 as numpy's Generator consumes them, so the
 * bytes are bench.py's own at a fraction of its per-line Python cost.
 *
 * - A 32-bit draw takes the low word of the next raw output and keeps its
 *   high word in a one-word buffer for the next 32-bit draw (pcg64_next32).
 * - A double takes a whole raw output, (x >> 11) * 2^-53, and leaves the
 *   buffer as it is (pcg64_next64, next_double).
 * - Generator.integers(0, n) is Lemire's method on 32 bits
 *   (buffered_bounded_lemire_uint32): m = x * n, drawn again while the low
 *   word of m is under 2^32 mod n, the value m >> 32.
 *
 * Built with the system compiler by krep_tpu_torch/tools/bench.py.
 */
#include <stdint.h>
#include <string.h>

typedef struct {
    const uint64_t *raw;
    int64_t n, j, buf; /* buf: the raw output whose high word waits, or -1 */
    int over;          /* a draw went past the raw outputs given */
} stream_t;

static inline uint32_t next32(stream_t *s) {
    if (s->buf >= 0) {
        uint32_t v = (uint32_t)(s->raw[s->buf] >> 32);
        s->buf = -1;
        return v;
    }
    if (s->j >= s->n) {
        s->over = 1;
        return UINT32_MAX; /* accepted by every bound below: the line is dropped */
    }
    s->buf = s->j;
    return (uint32_t)s->raw[s->j++];
}

static inline uint32_t bounded(stream_t *s, uint32_t n) {
    const uint32_t threshold = (uint32_t)((UINT64_C(1) << 32) % n);
    for (;;) {
        uint64_t m = (uint64_t)next32(s) * n;
        if ((uint32_t)m >= threshold)
            return (uint32_t)(m >> 32);
    }
}

static inline double next_double(stream_t *s) {
    if (s->j >= s->n) {
        s->over = 1;
        return 1.0;
    }
    return (double)(s->raw[s->j++] >> 11) * (1.0 / 9007199254740992.0);
}

/* Whole lines of bench.py's recipe into out, from the draw state
 * state = {j, buf}, until `cap` bytes are written or the raw outputs run
 * out (a line whose draws would pass them is not written). A line is k in
 * [3, 9) words drawn from n_words (their bytes at words + offs[i], lens[i]
 * long) joined by spaces, then '\n'; with n_ing > 0, in ~3% of lines
 * (double < 0.03) one word, at an index drawn after the 'ing' word itself,
 * becomes word n_words + [0, n_ing). out needs room for cap bytes plus one
 * line. Returns the bytes written; state holds the draw state after them. */
int64_t krep_corpus_lines(const uint64_t *raw, int64_t n_raw, int64_t *state,
                          const uint8_t *words, const int64_t *offs, const int64_t *lens,
                          int64_t n_words, int64_t n_ing, uint8_t *out, int64_t cap) {
    stream_t s = {raw, n_raw, state[0], state[1], 0};
    int64_t w = 0;
    uint32_t idx[8];
    while (w < cap) {
        stream_t line = s;
        uint32_t k = 3 + bounded(&line, 6);
        for (uint32_t i = 0; i < k; i++)
            idx[i] = bounded(&line, (uint32_t)n_words);
        if (n_ing > 0 && next_double(&line) < 0.03) {
            uint32_t word = (uint32_t)n_words + bounded(&line, (uint32_t)n_ing);
            idx[bounded(&line, k)] = word;
        }
        if (line.over)
            break;
        s = line;
        for (uint32_t i = 0; i < k; i++) {
            memcpy(out + w, words + offs[idx[i]], (size_t)lens[idx[i]]);
            w += lens[idx[i]];
            out[w++] = i + 1 < k ? ' ' : '\n';
        }
    }
    state[0] = s.j;
    state[1] = s.buf;
    return w;
}
