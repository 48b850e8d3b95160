/* TIFF LZW (compression 5) in plain C, for the benchmark's own GeoTIFF
 * writer (inputs) and reader (the program's outputs).
 *
 * Codes are packed most significant bit first. 256 clears the table, 257 ends
 * the strip, and new codes start at 258. The width grows one code early, as
 * libtiff writes it: the encoder widens when its next free code reaches 512,
 * 1024 and 2048, the decoder when its table reaches 511, 1023 and 2047
 * entries. The encoder clears when its next free code reaches 4094.
 *
 * Build: cc -O2 -shared -fPIC -o libpblzw.so lzw.c
 */

#include <stdint.h>
#include <string.h>

#define CLEAR 256
#define EOI 257
#define FIRST 258
#define HSIZE 9973

typedef struct {
    uint8_t* dst;
    long long cap;
    long long pos;
    uint32_t acc;
    int nacc;
    int overflow;
} BitWriter;

static void put(BitWriter* w, uint32_t code, int nbits) {
    w->acc = (w->acc << nbits) | code;
    w->nacc += nbits;
    while (w->nacc >= 8) {
        w->nacc -= 8;
        if (w->pos >= w->cap) { w->overflow = 1; return; }
        w->dst[w->pos++] = (uint8_t)(w->acc >> w->nacc);
    }
    w->acc &= (1u << w->nacc) - 1u;
}

static void flush(BitWriter* w) {
    if (w->nacc > 0) {
        if (w->pos >= w->cap) { w->overflow = 1; return; }
        w->dst[w->pos++] = (uint8_t)(w->acc << (8 - w->nacc));
        w->nacc = 0;
    }
}

/* Encodes src[0:n]; returns the bytes written to dst, or -1 if cap is short. */
long long pb_lzw_encode(const uint8_t* src, long long n, uint8_t* dst, long long cap) {
    static int32_t keys[HSIZE];
    static int16_t codes[HSIZE];
    BitWriter w = {dst, cap, 0, 0, 0, 0};
    int nbits = 9;
    int next = FIRST;
    for (int i = 0; i < HSIZE; i++) keys[i] = -1;
    put(&w, CLEAR, nbits);
    if (n == 0) {
        put(&w, EOI, nbits);
        flush(&w);
        return w.overflow ? -1 : w.pos;
    }
    int ent = src[0];
    for (long long i = 1; i < n; i++) {
        int c = src[i];
        int32_t key = (ent << 8) | c;
        int h = (int)(((uint32_t)key * 2654435761u) % HSIZE);
        int found = -1;
        while (keys[h] != -1) {
            if (keys[h] == key) { found = codes[h]; break; }
            h = (h + 1) % HSIZE;
        }
        if (found >= 0) { ent = found; continue; }
        put(&w, (uint32_t)ent, nbits);
        keys[h] = key;
        codes[h] = (int16_t)next;
        next++;
        if (next == 4094) {
            put(&w, CLEAR, nbits);
            for (int k = 0; k < HSIZE; k++) keys[k] = -1;
            next = FIRST;
            nbits = 9;
        } else if (next == 512 || next == 1024 || next == 2048) {
            nbits++;
        }
        ent = c;
    }
    put(&w, (uint32_t)ent, nbits);
    next++;
    if (next == 4094) {
        put(&w, CLEAR, nbits);
        nbits = 9;
    } else if (next == 512 || next == 1024 || next == 2048) {
        nbits++;
    }
    put(&w, EOI, nbits);
    flush(&w);
    return w.overflow ? -1 : w.pos;
}

/* Decodes src[0:n] into dst[0:cap]; returns the bytes written, or -1 on a
 * malformed stream or a short dst. */
long long pb_lzw_decode(const uint8_t* src, long long n, uint8_t* dst, long long cap) {
    static int32_t prefix[4096];
    static uint8_t suffix[4096];
    static uint8_t first[4096];
    static int32_t length[4096];
    static uint8_t stack[4096];
    for (int i = 0; i < 256; i++) {
        prefix[i] = -1; suffix[i] = (uint8_t)i; first[i] = (uint8_t)i; length[i] = 1;
    }
    long long out = 0;
    long long in = 0;
    uint64_t acc = 0;
    int nacc = 0;
    int nbits = 9;
    int size = FIRST;
    int old = -1;
    for (;;) {
        while (nacc < nbits && in < n) {
            acc = (acc << 8) | src[in++];
            nacc += 8;
        }
        if (nacc < nbits) break;
        uint32_t code = (uint32_t)(acc >> (nacc - nbits)) & ((1u << nbits) - 1u);
        nacc -= nbits;
        if (code == EOI) break;
        if (code == CLEAR) {
            size = FIRST;
            nbits = 9;
            old = -1;
            continue;
        }
        int cur;
        if (old < 0) {
            if (code > 255) return -1;
            if (out >= cap) return -1;
            dst[out++] = (uint8_t)code;
            old = (int)code;
            continue;
        }
        uint8_t head;
        if ((int)code < size) {
            cur = (int)code;
            head = first[cur];
        } else if ((int)code == size) {
            cur = -1;
            head = first[old];
        } else {
            return -1;
        }
        if (size < 4096) {
            prefix[size] = old;
            suffix[size] = head;
            first[size] = first[old];
            length[size] = length[old] + 1;
            size++;
        }
        int emit = cur >= 0 ? cur : size - 1;
        int len = length[emit];
        if (out + len > cap) return -1;
        int k = len;
        for (int e = emit; e >= 0; e = prefix[e]) stack[--k] = suffix[e];
        memcpy(dst + out, stack, (size_t)len);
        out += len;
        old = (int)code;
        if (size == 511 || size == 1023 || size == 2047) nbits++;
    }
    return out;
}
