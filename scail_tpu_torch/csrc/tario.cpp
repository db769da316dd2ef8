// Native tar-shard IO for the streaming data loader (a copy of the JAX
// package's csrc/tario.cpp; reference: sat/data_utils/webds.py, which
// streams webdataset tars through Python tarfile).
//
// Scans ustar/GNU/pax archives in one sequential pass over the header
// blocks and serves member reads with pread(2), so Python threads fetch
// payloads with the GIL released (ctypes releases it around foreign
// calls) while the host feeds the card.
//
// Plain C ABI, built with g++ at first use and loaded with ctypes by
// scail_tpu_torch/native/tario.py.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <string>

#include <fcntl.h>
#include <unistd.h>

namespace {

// octal or GNU base-256 size field
int64_t field_value(const char* p, int len) {
    if ((unsigned char)p[0] & 0x80) {  // base-256 (GNU large files)
        int64_t v = (unsigned char)p[0] & 0x7f;
        for (int i = 1; i < len; ++i) v = (v << 8) | (unsigned char)p[i];
        return v;
    }
    int64_t v = 0;
    for (int i = 0; i < len && p[i]; ++i) {
        if (p[i] >= '0' && p[i] <= '7') v = v * 8 + (p[i] - '0');
    }
    return v;
}

}  // namespace

extern "C" {

// Scan a tar file.  For each regular-file member, writes its payload
// offset and size, and appends its NUL-terminated name to `names`.
// Returns the member count, -1 on IO error, -2 if names_cap or
// max_entries is too small, -3 if the archive is truncated mid-member
// (short header, payload running past EOF, or missing end-of-archive
// zero block) -- matching Python tarfile, which raises ReadError in the
// same situations, so a damaged shard raises instead of silently
// dropping samples.  Handles ustar name+prefix, GNU
// longname ('L') and pax extended-header ('x', path= record) entries;
// skips everything else that is not a regular file.
int64_t tar_scan(const char* path, int64_t* offsets, int64_t* sizes,
                 char* names, int64_t names_cap, int64_t max_entries) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    std::fseek(f, 0, SEEK_END);
    int64_t fsize = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    char hdr[512];
    std::string longname;
    int64_t pax_size = -1;
    int64_t count = 0, names_used = 0;
    bool clean_end = false;
    for (;;) {
        size_t got = std::fread(hdr, 1, 512, f);
        if (got == 0) {  // EOF exactly at a header boundary: tarfile
            clean_end = true;  // tolerates a missing end marker here too
            break;
        }
        if (got != 512) break;        // partial header: truncated
        bool empty = true;
        for (int i = 0; i < 512 && empty; ++i) empty = hdr[i] == 0;
        if (empty) {  // first of the two terminating zero blocks
            clean_end = true;
            break;
        }
        int64_t size = field_value(hdr + 124, 12);
        char type = hdr[156];
        if (type != 'x' && type != 'L' && pax_size >= 0) {
            size = pax_size;  // pax size= record overrides the ustar field
            pax_size = -1;
        }
        int64_t payload = (size + 511) / 512 * 512;
        // fseek past EOF "succeeds" on regular files, so bound-check the
        // payload against the real file size before seeking over it
        if (std::ftell(f) + payload > fsize) break;  // truncated member
        if (type == 'L') {  // GNU long name: payload is the real name
            if (size < 4096) {
                std::string buf(size, '\0');
                if (std::fread(&buf[0], 1, size, f) != (size_t)size) break;
                longname.assign(buf.c_str());
                if (std::fseek(f, payload - size, SEEK_CUR) != 0) break;
                continue;
            }
        }
        if (type == 'x') {  // pax extended header: "len path=value\n" records
            if (size < 1 << 20) {
                std::string buf(size, '\0');
                if (std::fread(&buf[0], 1, size, f) != (size_t)size) break;
                size_t pos = 0;
                while (pos < buf.size()) {
                    size_t sp = buf.find(' ', pos);
                    if (sp == std::string::npos) break;
                    long rec = std::strtol(buf.c_str() + pos, nullptr, 10);
                    if (rec <= 0 || pos + rec > buf.size()) break;
                    std::string kv = buf.substr(sp + 1, pos + rec - sp - 2);
                    if (kv.rfind("path=", 0) == 0) longname = kv.substr(5);
                    if (kv.rfind("size=", 0) == 0)
                        pax_size = std::strtoll(kv.c_str() + 5, nullptr, 10);
                    pos += rec;
                }
                if (std::fseek(f, payload - size, SEEK_CUR) != 0) break;
                continue;
            }
        }
        if (type == '0' || type == '\0') {
            std::string name;
            if (!longname.empty()) {
                name.swap(longname);
            } else {
                char nbuf[101], pbuf[156];
                std::memcpy(nbuf, hdr, 100);
                nbuf[100] = 0;
                std::memcpy(pbuf, hdr + 345, 155);
                pbuf[155] = 0;
                name = pbuf[0] ? std::string(pbuf) + "/" + nbuf : nbuf;
            }
            if (count >= max_entries ||
                names_used + (int64_t)name.size() + 1 > names_cap) {
                std::fclose(f);
                return -2;
            }
            offsets[count] = std::ftell(f);
            sizes[count] = size;
            std::memcpy(names + names_used, name.c_str(), name.size() + 1);
            names_used += name.size() + 1;
            ++count;
        } else {
            longname.clear();
            pax_size = -1;
        }
        if (std::fseek(f, payload, SEEK_CUR) != 0) break;
    }
    std::fclose(f);
    return clean_end ? count : -3;
}

// pread a member payload.  Returns bytes read (== size on success),
// -1 on open failure.
int64_t tar_pread(const char* path, int64_t offset, int64_t size,
                  uint8_t* out) {
    int fd = open(path, O_RDONLY);
    if (fd < 0) return -1;
    int64_t done = 0;
    while (done < size) {
        ssize_t n = pread(fd, out + done, size - done, offset + done);
        if (n <= 0) break;
        done += n;
    }
    close(fd);
    return done;
}

}  // extern "C"
