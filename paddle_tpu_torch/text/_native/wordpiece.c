/* Native WordPiece tokenizer core (the port's own copy of
 * paddle_tpu/text/_native/wordpiece.c).
 *
 * Reference analog: PaddleNLP's faster_tokenizer C++ core (the reference
 * framework ships tokenization as native code; python/paddle has no
 * tokenizer, so this follows the canonical BERT WordPiece semantics:
 * whitespace pre-split, ASCII punctuation isolation, greedy
 * longest-match-first subword segmentation with "##" continuations).
 *
 * Plain C ABI for ctypes (no pybind11 in the image).  The vocabulary is
 * stored as a sorted string table; lookups are binary search (O(log V),
 * V ~ 30k).  UTF-8 multibyte sequences pass through opaquely as word
 * bytes (the python side handles any unicode normalization).
 *
 * API:
 *   wp_new(packed, offsets, n)   -> handle   (packed = NUL-joined vocab,
 *                                             MUST be sorted ascending)
 *   wp_free(handle)
 *   wp_encode(handle, text, unk_id, max_word_len, out, cap) -> n_ids
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct {
    char *packed;          /* owned copy of the NUL-joined vocab */
    const char **words;    /* sorted pointers into packed */
    int32_t n;
    int32_t maxlen;        /* longest vocab token in bytes (incl. "##") */
} wp_t;

void *wp_new(const char *packed, const int64_t *offsets, int32_t n,
             int64_t packed_len) {
    wp_t *h = (wp_t *)malloc(sizeof(wp_t));
    if (!h) return 0;
    h->packed = (char *)malloc((size_t)packed_len);
    h->words = (const char **)malloc(sizeof(char *) * (size_t)n);
    if (!h->packed || !h->words) { free(h->packed); free(h->words);
                                   free(h); return 0; }
    memcpy(h->packed, packed, (size_t)packed_len);
    h->maxlen = 1;
    for (int32_t i = 0; i < n; i++) {
        h->words[i] = h->packed + offsets[i];
        int32_t l = (int32_t)strlen(h->words[i]);
        if (l > h->maxlen) h->maxlen = l;
    }
    h->n = n;
    return h;
}

void wp_free(void *handle) {
    wp_t *h = (wp_t *)handle;
    if (!h) return;
    free(h->packed);
    free((void *)h->words);
    free(h);
}

/* binary search; returns vocab index or -1 */
static int32_t wp_lookup(const wp_t *h, const char *s, int len) {
    int32_t lo = 0, hi = h->n - 1;
    while (lo <= hi) {
        int32_t mid = lo + (hi - lo) / 2;
        int c = strncmp(h->words[mid], s, (size_t)len);
        if (c == 0 && h->words[mid][len] != '\0') c = 1;
        if (c == 0) return mid;
        if (c < 0) lo = mid + 1; else hi = mid - 1;
    }
    return -1;
}

static int is_ws(unsigned char c) {
    return c == ' ' || c == '\t' || c == '\n' || c == '\r';
}

static int is_punct(unsigned char c) {
    /* ASCII punctuation, BERT BasicTokenizer rule */
    return (c >= 33 && c <= 47) || (c >= 58 && c <= 64) ||
           (c >= 91 && c <= 96) || (c >= 123 && c <= 126);
}

/* greedy wordpiece over one word; returns ids written (or emits unk) */
static int64_t wp_word(const wp_t *h, const char *w, int wlen,
                       int32_t unk_id, int max_word_len,
                       int32_t *out, int64_t cap, int64_t pos) {
    char buf[512];
    if (wlen > max_word_len || wlen + 2 >= (int)sizeof(buf)) {
        if (pos < cap) out[pos] = unk_id;
        return pos + 1;
    }
    int start = 0;
    int64_t first = pos;
    while (start < wlen) {
        /* trials longer than the longest vocab token can never match;
         * with a "##" prefix the budget shrinks by 2 */
        int maxsub = (start > 0) ? h->maxlen - 2 : h->maxlen;
        if (maxsub < 1) maxsub = 1;
        int end = wlen, found = -1;
        if (end > start + maxsub) end = start + maxsub;
        const char *sub = w + start;
        if (start > 0) {
            /* copy once per start (trials only vary the length) — and only
             * the bytes the clamped longest trial can use */
            buf[0] = '#'; buf[1] = '#';
            memcpy(buf + 2, w + start, (size_t)(end - start));
            sub = buf;
        }
        while (end > start) {
            int sublen = end - start + (start > 0 ? 2 : 0);
            found = wp_lookup(h, sub, sublen);
            if (found >= 0) break;
            end--;
        }
        if (found < 0) {           /* unsegmentable -> single unk */
            if (first < cap) out[first] = unk_id;
            return first + 1;
        }
        if (pos < cap) out[pos] = found;
        pos++;
        start = end;
    }
    return pos;
}

int64_t wp_encode(void *handle, const char *text, int32_t unk_id,
                  int32_t max_word_len, int32_t *out, int64_t cap) {
    const wp_t *h = (const wp_t *)handle;
    int64_t pos = 0;
    const char *p = text;
    while (*p) {
        while (*p && is_ws((unsigned char)*p)) p++;
        if (!*p) break;
        if (is_punct((unsigned char)*p)) {       /* punct = own token */
            pos = wp_word(h, p, 1, unk_id, max_word_len, out, cap, pos);
            p++;
            continue;
        }
        const char *start = p;
        while (*p && !is_ws((unsigned char)*p)
               && !is_punct((unsigned char)*p)) p++;
        pos = wp_word(h, start, (int)(p - start), unk_id, max_word_len,
                      out, cap, pos);
    }
    return pos;
}

#ifdef __cplusplus
}  /* extern "C" */
#endif
