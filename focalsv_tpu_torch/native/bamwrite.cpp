// One call writes a whole BAM from column arrays: it encodes every record as
// io/bam.py::encode_record does, cuts the header-plus-records stream into
// BGZF blocks where io/bam.py::BgzfWriter cuts it (every 65,000 bytes, the
// remainder at the end), deflates each block with zlib as BgzfWriter does,
// appends the EOF block and writes the lot to an open file descriptor: the
// same file, byte for byte.  Called through ctypes, it runs without the
// Python interpreter lock, so the region writers of a thread pool compress
// side by side.
//
// Build: g++ -O3 -shared -fPIC bamwrite.cpp -lz

#include <algorithm>
#include <cerrno>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <unistd.h>
#include <vector>
#include <zlib.h>

namespace {

constexpr int64_t kBlock = 65000;     // BgzfWriter's block of input bytes

const uint8_t kCodeToNib[6] = {1, 2, 4, 8, 15, 15};   // A C G T N PAD->N
const bool kConsumesRef[9] = {1, 0, 1, 1, 0, 0, 0, 1, 1};
const uint8_t kEof[28] = {
    0x1f, 0x8b, 0x08, 0x04, 0x00, 0x00, 0x00, 0x00, 0x00, 0xff, 0x06, 0x00,
    0x42, 0x43, 0x02, 0x00, 0x1b, 0x00, 0x03, 0x00, 0x00, 0x00, 0x00, 0x00,
    0x00, 0x00, 0x00, 0x00};

enum : int64_t {
    kOk = 0,
    kBadField = -1,   // a value encode_record would refuse (the fallback raises)
    kDeflate = -2,
    kWrite = -3,
};

int64_t reg2bin(int64_t beg, int64_t end) {
    --end;
    if (beg >> 14 == end >> 14) return ((1 << 15) - 1) / 7 + (beg >> 14);
    if (beg >> 17 == end >> 17) return ((1 << 12) - 1) / 7 + (beg >> 17);
    if (beg >> 20 == end >> 20) return ((1 << 9) - 1) / 7 + (beg >> 20);
    if (beg >> 23 == end >> 23) return ((1 << 6) - 1) / 7 + (beg >> 23);
    if (beg >> 26 == end >> 26) return ((1 << 3) - 1) / 7 + (beg >> 26);
    return 0;
}

bool fits_i32(int64_t v) { return v >= INT32_MIN && v <= INT32_MAX; }

uint8_t* le32(uint8_t* p, uint32_t v) {
    for (int k = 0; k < 4; ++k) *p++ = uint8_t(v >> (8 * k));
    return p;
}

uint8_t* le16(uint8_t* p, uint32_t v) {
    *p++ = uint8_t(v);
    *p++ = uint8_t(v >> 8);
    return p;
}

uint8_t* tag_i32(uint8_t* p, const char* tag, int64_t v) {
    *p++ = uint8_t(tag[0]);
    *p++ = uint8_t(tag[1]);
    *p++ = 'i';
    return le32(p, uint32_t(v));
}

// Raw deflate of src[0, n) into dst as zlib.compressobj(level, DEFLATED,
// -15) (memLevel 8, the default strategy) with compress(src) then flush();
// returns the compressed size, or -1.
int64_t deflate_raw(int level, const uint8_t* src, int64_t n, uint8_t* dst,
                    int64_t cap) {
    z_stream s;
    std::memset(&s, 0, sizeof(s));
    if (deflateInit2(&s, level, Z_DEFLATED, -15, 8, Z_DEFAULT_STRATEGY)
        != Z_OK)
        return -1;
    s.next_in = const_cast<uint8_t*>(src);
    s.avail_in = uInt(n);
    s.next_out = dst;
    s.avail_out = uInt(cap);
    int rc = deflate(&s, Z_NO_FLUSH);
    if (rc == Z_OK) rc = deflate(&s, Z_FINISH);
    const int64_t got = int64_t(s.total_out);
    deflateEnd(&s);
    return rc == Z_STREAM_END ? got : -1;
}

// Appends one BGZF block holding src[0, n) to `out`.
int64_t put_block(int level, const uint8_t* src, int64_t n,
                  std::vector<uint8_t>& out) {
    const int64_t cap = n + n / 2 + 1024;
    const size_t at = out.size();
    out.resize(at + 18 + cap + 8);
    uint8_t* h = out.data() + at;
    const int64_t clen = deflate_raw(level, src, n, h + 18, cap);
    if (clen < 0) return kDeflate;
    const int64_t bsize = clen + 25;   // the block's size less one
    if (bsize > 0xFFFF) return kDeflate;
    const uint8_t head[18] = {0x1f, 0x8b, 0x08, 0x04, 0, 0, 0, 0, 0, 0xff,
                              6, 0, 0x42, 0x43, 2, 0, uint8_t(bsize),
                              uint8_t(bsize >> 8)};
    std::memcpy(h, head, 18);
    le32(le32(h + 18 + clen, uint32_t(crc32(0L, src, uInt(n)))), uint32_t(n));
    out.resize(at + 18 + clen + 8);
    return kOk;
}

}  // namespace

extern "C" {

// Writes `prefix` (bytes of the stream not yet in a block, under 65,000:
// the header of a fresh file) followed by n records, as BGZF blocks and
// the EOF block, at fd's current offset.  Per record i:
//   fixed[7 * i + 0..6]: ref_id, pos, mapq, flag, next_ref, next_pos, tlen;
//   names[name_off[i], name_off[i + 1]): the name, without its NUL;
//   cigar[2 * k], cigar[2 * k + 1] for k in [cig_off[i], cig_off[i + 1]):
//     op and length;
//   seq[seq_off[i], seq_off[i + 1]): base codes 0-5 (A C G T N pad);
//   qual[qual_off[i], qual_off[i + 1]): qualities, written where their
//     count equals the sequence's, else 0xFF for each base;
//   tags[tag_off[i], tag_off[i + 1]): the read's encoded tags; where that
//     span is empty and hp[i] > 0, "HPi" hp[i] then "PSi" ps[i].
// Nothing is written unless every record encodes and every block deflates.
// Returns 0; kBadField (-1) when a record holds a value encode_record
// refuses, having written nothing; kDeflate (-2) when zlib fails, having
// written nothing; kWrite (-3) with errno set when write() fails, perhaps
// after part of the file.
int64_t bamwrite_records(int fd, const uint8_t* prefix, int64_t prefix_len,
                         int64_t n, const int64_t* fixed,
                         const uint8_t* names, const int64_t* name_off,
                         const int32_t* cigar, const int64_t* cig_off,
                         const uint8_t* seq, const int64_t* seq_off,
                         const uint8_t* qual, const int64_t* qual_off,
                         const uint8_t* tags, const int64_t* tag_off,
                         const int64_t* hp, const int64_t* ps, int level) {
    // pass 1: every record's body size; refuse what encode_record refuses
    std::vector<int64_t> body(size_t(n) + 1);
    int64_t total = prefix_len;
    for (int64_t i = 0; i < n; ++i) {
        const int64_t* fx = fixed + 7 * i;
        const int64_t pos = fx[1], mapq = fx[2], flag = fx[3];
        const int64_t l_name = name_off[i + 1] - name_off[i] + 1;
        const int64_t n_cig = cig_off[i + 1] - cig_off[i];
        const int64_t l_seq = seq_off[i + 1] - seq_off[i];
        const int32_t* cg = cigar + 2 * cig_off[i];
        int64_t ref_len = 0;
        for (int64_t k = 0; k < n_cig; ++k) {
            const int32_t op = cg[2 * k];
            if (op < 0 || op > 8) return kBadField;
            if (kConsumesRef[op]) ref_len += cg[2 * k + 1];
        }
        const int64_t bin = reg2bin(pos, std::max(pos + ref_len, pos + 1));
        if (!fits_i32(fx[0]) || !fits_i32(pos) || !fits_i32(fx[4]) ||
            !fits_i32(fx[5]) || !fits_i32(fx[6]) || !fits_i32(l_seq) ||
            l_name > 0xFF || mapq < 0 || mapq > 0xFF || bin < 0 ||
            bin > 0xFFFF || n_cig > 0xFFFF || flag < 0 || flag > 0xFFFF)
            return kBadField;
        const uint8_t* sq = seq + seq_off[i];
        for (int64_t k = 0; k < l_seq; ++k)
            if (sq[k] > 5) return kBadField;
        const bool hp_ps = tag_off[i + 1] == tag_off[i] && hp[i] > 0;
        if (hp_ps && (!fits_i32(hp[i]) || !fits_i32(ps[i])))
            return kBadField;
        const int64_t l_tags = hp_ps ? 14 : tag_off[i + 1] - tag_off[i];
        body[i] = 32 + l_name + 4 * n_cig + (l_seq + 1) / 2 + l_seq + l_tags;
        if (!fits_i32(body[i])) return kBadField;
        total += 4 + body[i];
    }
    // pass 2: the stream, header and records, as encode_record lays it out
    std::vector<uint8_t> s(static_cast<size_t>(total));
    uint8_t* p = s.data();
    std::memcpy(p, prefix, size_t(prefix_len));
    p += prefix_len;
    for (int64_t i = 0; i < n; ++i) {
        const int64_t* fx = fixed + 7 * i;
        const int64_t pos = fx[1];
        const int64_t l_name = name_off[i + 1] - name_off[i] + 1;
        const int64_t n_cig = cig_off[i + 1] - cig_off[i];
        const int64_t l_seq = seq_off[i + 1] - seq_off[i];
        const int32_t* cg = cigar + 2 * cig_off[i];
        int64_t ref_len = 0;
        for (int64_t k = 0; k < n_cig; ++k)
            if (kConsumesRef[cg[2 * k]]) ref_len += cg[2 * k + 1];
        p = le32(p, uint32_t(body[i]));
        p = le32(p, uint32_t(fx[0]));
        p = le32(p, uint32_t(pos));
        *p++ = uint8_t(l_name);
        *p++ = uint8_t(fx[2]);
        p = le16(p, uint32_t(reg2bin(pos, std::max(pos + ref_len, pos + 1))));
        p = le16(p, uint32_t(n_cig));
        p = le16(p, uint32_t(fx[3]));
        p = le32(p, uint32_t(l_seq));
        p = le32(p, uint32_t(fx[4]));
        p = le32(p, uint32_t(fx[5]));
        p = le32(p, uint32_t(fx[6]));
        std::memcpy(p, names + name_off[i], size_t(l_name - 1));
        p += l_name - 1;
        *p++ = 0;
        for (int64_t k = 0; k < n_cig; ++k)
            p = le32(p, (uint32_t(cg[2 * k + 1]) << 4) | uint32_t(cg[2 * k]));
        const uint8_t* sq = seq + seq_off[i];
        for (int64_t k = 0; k + 1 < l_seq; k += 2)
            *p++ = uint8_t(kCodeToNib[sq[k]] << 4 | kCodeToNib[sq[k + 1]]);
        if (l_seq % 2) *p++ = uint8_t(kCodeToNib[sq[l_seq - 1]] << 4);
        if (qual_off[i + 1] - qual_off[i] == l_seq)
            std::memcpy(p, qual + qual_off[i], size_t(l_seq));
        else
            std::memset(p, 0xFF, size_t(l_seq));
        p += l_seq;
        if (tag_off[i + 1] == tag_off[i] && hp[i] > 0) {
            p = tag_i32(p, "HP", hp[i]);
            p = tag_i32(p, "PS", ps[i]);
        } else {
            std::memcpy(p, tags + tag_off[i], size_t(tag_off[i + 1] - tag_off[i]));
            p += tag_off[i + 1] - tag_off[i];
        }
    }
    std::vector<uint8_t> out;
    out.reserve(s.size() / 3 + 1024);
    for (int64_t at = 0; at < total; at += kBlock) {
        const int64_t len = total - at < kBlock ? total - at : kBlock;
        const int64_t rc = put_block(level, s.data() + at, len, out);
        if (rc != kOk) return rc;
    }
    out.insert(out.end(), kEof, kEof + sizeof(kEof));
    size_t done = 0;
    while (done < out.size()) {
        const ssize_t w = write(fd, out.data() + done, out.size() - done);
        if (w < 0) {
            if (errno == EINTR) continue;
            return kWrite;
        }
        done += size_t(w);
    }
    return kOk;
}

}  // extern "C"
